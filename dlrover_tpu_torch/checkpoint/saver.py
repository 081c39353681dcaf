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

The saver also runs the two host-level rungs of the restore chain that
the JAX saver runs:

- peer replicas (``checkpoint/replica.py``): in a world of several hosts
  each REPLICATE event (one after every stage) goes to a bounded queue; a
  worker thread collapses it to the newest staged image, copies that
  image out of shm into a private buffer under the shard lock (the copy
  only) and pushes the buffer to the backup peer with the lock released.
  The JAX worker streams straight out of shm without the lock and pushes
  again when the step changed under it; here no network transfer ever
  runs under the lock, and the trainer never stages into bytes in flight.
  The saver also serves this host's replica store, and
  :meth:`prefetch_restore` refills an empty shm from the peer;
- the durable tier (``checkpoint/durable/``): once a persist has written
  this host's shard of a step that ``durable_every`` divides, the buffer
  it wrote from is lent to the :class:`DurableWriter`, which streams it
  to the lineage on its own thread and hands it back; a third buffer is
  made only while both others are in use. The JAX saver submits the step
  only when its own commit call wrote the commit marker, which with a
  storage root shared by several hosts is only the last host to finish,
  so the others never drain and rank 0's barrier times out; the port
  submits on this host's shard, and the durable commit's barrier waits
  for every host.

Every wait is bounded: the runner and event loops poll their queues and
check a stop flag, the snapshots wait for the shard lock at most
``SNAPSHOT_LOCK_S``, replica transfers have ``ckpt_replica_timeout_s``,
and :meth:`AsyncCheckpointSaver.shutdown` gives each hand-off and join a
deadline.
"""

import os
import queue as _queue
import signal
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Set, Tuple

import numpy as np

from ..common.config import get_context
from ..common.log import logger
from ..common.multi_process import LocalSocketClient, SharedLock, SharedQueue, _ipc_namespace
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


def _peer_map(peers) -> Optional[Dict[int, str]]:
    """Static replica peers by rank: the factory message is JSON, whose
    object keys are strings."""
    return None if peers is None else {int(rank): addr for rank, addr in peers.items()}


class CheckpointEvent:
    SAVE = "save"
    REPLICATE = "replicate"
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
                 replicate: bool = False, replica_peers: Optional[Dict[int, str]] = None,
                 durable_dir: str = "", durable_lineage: str = ""):
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
        self._fault_lock = threading.Lock()
        self._persist_lock = threading.Lock()  # one write at a time
        self._writer: Optional[threading.Thread] = None
        # per persist: step, shard-lock hold of its snapshot, write seconds
        self.persist_stats: Deque[Dict[str, float]] = deque(maxlen=1000)
        # buffers lent to the durable writer
        self._lent: Set[int] = set()
        self.master_client = None  # the replica KV and the durable barrier
        self.replica_manager = None
        self._replica_peers = _peer_map(replica_peers)
        self._replicate_q: Optional[_queue.Queue] = None
        self._replicate_thread: Optional[threading.Thread] = None
        self._replica_buf: Optional[np.ndarray] = None
        self._pushed: Optional[Tuple[int, float]] = None  # (step, timestamp) of the last push
        # per push: step, bytes, shard-lock hold of its copy, push seconds, ok
        self.replica_stats: Deque[Dict] = deque(maxlen=1000)
        self._durable_writer = None
        self._durable_every = 1
        self._reconfigure_durable(durable_dir, durable_lineage)
        if replicate and num_hosts > 1:
            self._start_replication()

    def _reconfigure_durable(self, durable_dir: str, durable_lineage: str) -> None:
        """(Re)build the durable writer for the current config and shard
        topology; a writer for another root, lineage or world is stopped
        and replaced."""
        w = self._durable_writer
        if w is not None and (not durable_dir or w.layout.root != durable_dir
                              or (durable_lineage and w.layout.lineage != durable_lineage)
                              or w.host_rank != self.host_rank or w.num_hosts != self.num_hosts
                              or w.shm is not self.shm):
            w.stop()
            self._durable_writer = None
        if durable_dir and self._durable_writer is None:
            self._setup_durable(durable_dir, durable_lineage)

    def _setup_durable(self, durable_dir: str, durable_lineage: str) -> None:
        """The durable writer, with the commit barrier in the master's KV
        store when a master is reachable, else in the done files."""
        from .durable.writer import DurableWriter
        from .replica import default_master_client

        ctx = get_context()
        lineage = (durable_lineage or ctx.durable_lineage or os.environ.get("DLROVER_JOB_NAME", "")
                   or "default")
        client = self.master_client or default_master_client()
        try:
            self._durable_writer = DurableWriter(
                durable_dir, lineage, self.host_rank, self.num_hosts, self.shm,
                shard_lock=self._shard_lock, master_client=client, keep=ctx.durable_keep,
                commit_timeout_s=ctx.durable_commit_timeout_s)
            self._durable_every = max(1, ctx.durable_every)
        except Exception:  # noqa: BLE001 — the durable tier is optional; the flash tier goes on
            logger.exception("durable writer failed to start")
            self._durable_writer = None

    def _start_replication(self) -> None:
        """Serve this host's replica store, register its address and start
        the push worker."""
        from .replica import ReplicaManager, default_master_client

        client = self.master_client
        if client is None and self._replica_peers is None:
            client = default_master_client()
        try:
            self.replica_manager = ReplicaManager(self.host_rank, self.num_hosts,
                                                  master_client=client, peers=self._replica_peers)
            self.replica_manager.start()
        except Exception:  # noqa: BLE001 — replication is best-effort
            logger.exception("replica manager failed to start")
            self.replica_manager = None
            return
        if self._replicate_thread is None or not self._replicate_thread.is_alive():
            self._replicate_q = _queue.Queue(maxsize=64)
            self._replicate_thread = threading.Thread(target=self._replicate_worker,
                                                      name="ckpt-replicate", daemon=True)
            self._replicate_thread.start()

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
                            replica_peers=msg.get("replica_peers"),
                            durable_dir=msg.get("durable_dir", ""),
                            durable_lineage=msg.get("durable_lineage", ""),
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
                      replicate: bool = False, replica_peers: Optional[Dict[int, str]] = None,
                      durable_dir: str = "", durable_lineage: str = "") -> "AsyncCheckpointSaver":
        with cls._cls_lock:
            inst = cls._instance
            if inst is None:
                cls._instance = cls(storage_root, host_rank, num_hosts, replicate=replicate,
                                    replica_peers=replica_peers, durable_dir=durable_dir,
                                    durable_lineage=durable_lineage)
                return cls._instance
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
                inst._pushed = None
                if inst.replica_manager is not None:
                    inst.replica_manager.stop()
                    inst.replica_manager = None
            if replicate and num_hosts > 1:
                inst._replica_peers = _peer_map(replica_peers)
                if inst.replica_manager is None:
                    inst._start_replication()
            elif inst.replica_manager is not None:
                # replication turned off: stop serving, unregister
                inst.replica_manager.stop()
                inst.replica_manager = None
            inst._reconfigure_durable(durable_dir, durable_lineage)
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
            if etype == CheckpointEvent.REPLICATE:
                self._replicate_step(event.get("step", -1))
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
                elif etype == CheckpointEvent.REPLICATE:
                    self._replicate_step(event.get("step", -1))
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
        """Buffer ``idx``, grown to ``nbytes``, its pages touched at once (a
        page fault each, not one per copied chunk)."""
        buf = self._bufs[idx]
        if buf is None or buf.nbytes < nbytes:
            self._bufs[idx] = None  # drop the old one before the new one
            buf = np.empty(nbytes, dtype=np.uint8)
            buf.fill(0)
            self._bufs[idx] = buf
        return buf

    def _free_buffer(self) -> int:
        """The buffer a snapshot fills: the pending snapshot's (latest wins),
        else one that the writer is not reading and the durable writer has
        not borrowed (a third is added while both are in use)."""
        with self._slot:
            if self._pending is not None:
                return self._pending[1]
            for idx in range(len(self._bufs)):
                if idx != self._writing and idx not in self._lent:
                    return idx
            self._bufs.append(None)
            return len(self._bufs) - 1

    def _return_buffer(self, idx: int) -> None:
        with self._slot:
            self._lent.discard(idx)

    def _snapshot(self, step: int) -> bool:
        """Copy the staged image out of shm into a private buffer, under the
        shard lock and for no longer than the copy, and leave it for the
        writer, replacing a snapshot it has not taken yet (latest wins).
        False when there is nothing new to write. The segment's pages are
        read into this process and the buffer is made before the lock is
        taken (:meth:`_prepare_copy`). No stage lands over the step a SAVE
        asked for meanwhile: the engine's storage stage hands the lock on
        to this saver (``release(hold_off_s=...)``), and the trainer's
        stages are skipped until this copy has claimed it (a replica push
        takes the lock without the claim)."""
        with self._snap_lock:
            self._prepare_copy()
            got = self._copy_out(step)
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

    def _prepare_copy(self) -> None:
        """Outside the shard lock: read a new mapping's pages in and make
        the buffer the next copy fills as large as the staged image (read
        without the lock: a size hint only). A SAVE can arrive while its
        stage still writes the image (the header reads as absent then):
        this waits for the stage to release the lock, at most
        ``SNAPSHOT_LOCK_S``; the lock is handed on to this saver, so no
        other stage lands meanwhile."""
        meta = self.shm.read_meta()
        deadline = time.monotonic() + SNAPSHOT_LOCK_S
        while meta is None and time.monotonic() < deadline and self._shard_lock.locked():
            time.sleep(0.05)
            meta = self.shm.read_meta()
        self._fault_in()
        if meta is None:
            return
        with self._slot:
            idx = self._free_buffer()
            # a pending snapshot's buffer is the writer's to take: not
            # replaced here
            pending = self._pending is not None and self._pending[1] == idx
        if not pending:
            self._buffer(idx, meta.total_bytes)

    def _fault_in(self) -> None:
        """``shm.fault_in`` (a no-op once the mapping was read) on one
        thread at a time: the persist and the replica push both call it."""
        t0 = time.monotonic()
        with self._fault_lock:
            pages = self.shm.fault_in()
        if pages:
            logger.info("read %s pages of the shm segment into the saver in %.3f s", pages,
                        time.monotonic() - t0)

    def _copy_out(self, step: int):
        """Under the shard lock: (meta, buffer index, lock hold) of the
        staged image copied out, or None when there is nothing to copy. The
        acquire claims the lock that a storage stage handed on."""
        if not self._shard_lock.acquire(timeout=SNAPSHOT_LOCK_S, claim=True):
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
                self._pending = None  # refilled below: latest wins
            buf = self._bufs[idx]
            if buf is None or buf.nbytes < meta.total_bytes:
                # the image outgrew the size read before the lock
                logger.warning("snapshot buffer made under the shard lock (%s bytes)",
                               meta.total_bytes)
                buf = self._buffer(idx, meta.total_bytes)
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
            if self._durable_writer is not None and meta.step % self._durable_every == 0:
                # the buffer goes to the durable writer until it has written
                # it (see the module docstring)
                with self._slot:
                    self._lent.add(idx)
                self._durable_writer.submit(
                    meta.step, (meta, self._bufs[idx], lambda: self._return_buffer(idx)))
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

    # -- peer replicas -------------------------------------------------------

    def _replicate_step(self, step: int) -> None:
        """Hand the push to the replication worker: a transfer of the whole
        image must not hold up the SAVE events queued behind it."""
        if self.replica_manager is None or self._replicate_q is None:
            return
        try:
            self._replicate_q.put_nowait(step)
        except _queue.Full:
            logger.warning("replication backlog full; dropping step %s", step)

    def _replicate_worker(self) -> None:
        while self._running:
            try:
                self._replicate_q.get(timeout=_POLL_S)
            except _queue.Empty:
                continue
            # the backlog collapses: only the newest staged image matters
            try:
                while True:
                    self._replicate_q.get_nowait()
            except _queue.Empty:
                pass
            manager = self.replica_manager
            if manager is None:
                continue
            try:
                self._push_staged(manager)
            except Exception:  # noqa: BLE001 — replication is best-effort, as in JAX
                logger.exception("replica push failed")

    def _push_staged(self, manager) -> bool:
        """Copy the staged image out of shm (under the shard lock, the copy
        only) into the replica buffer and push the buffer to the backup
        peer. False when there is nothing new to push or the push failed."""
        got = self._copy_image()
        if got is None:
            return False
        meta, total, hold = got
        t0 = time.monotonic()
        with memoryview(self._replica_buf) as view:
            ok = manager.replicate(total, lambda offset, n: view[offset : offset + n])
        push_s = time.monotonic() - t0
        if ok:
            self._pushed = (meta.step, meta.timestamp)
        self.replica_stats.append({"step": meta.step, "bytes": total, "hold_s": hold,
                                   "push_s": push_s, "ok": ok})
        logger.info("replica push of step %s: %s bytes in %.3f s, ok=%s (shard lock held %.4f s)",
                    meta.step, total, push_s, ok, hold)
        return ok

    def _copy_image(self):
        """Under the shard lock: (meta, image bytes, lock hold) of the staged
        image copied into the replica buffer; None when there is no image
        or it was pushed already. The pages are read in and the buffer made
        before the lock, as for the persist's copy."""
        self._fault_in()
        size = self.shm.image_size()
        if size and (self._replica_buf is None or self._replica_buf.nbytes < size):
            self._replica_buf = None
            self._replica_buf = np.empty(size, dtype=np.uint8)
            self._replica_buf.fill(0)
        if not self._shard_lock.acquire(timeout=SNAPSHOT_LOCK_S):
            raise TimeoutError(f"shard lock not free within {SNAPSHOT_LOCK_S} s")
        try:
            t0 = time.monotonic()
            meta = self.shm.read_meta()
            if meta is None or (meta.step, meta.timestamp) == self._pushed:
                return None
            reader = self.shm.image_reader()
            total = self.shm.image_size()
            if reader is None:
                return None
            if self._replica_buf is None or self._replica_buf.nbytes < total:
                # the image outgrew the size read before the lock
                logger.warning("replica buffer made under the shard lock (%s bytes)", total)
                self._replica_buf = None
                self._replica_buf = np.empty(total, dtype=np.uint8)
                self._replica_buf.fill(0)
            with memoryview(self._replica_buf) as view:
                for offset in range(0, total, SNAPSHOT_CHUNK):
                    n = min(SNAPSHOT_CHUNK, total - offset)
                    with reader(offset, n) as chunk:
                        view[offset : offset + n] = chunk
            return meta, total, time.monotonic() - t0
        finally:
            self._shard_lock.release()

    def prefetch_restore(self) -> str:
        """Make this host's shm restorable before its worker boots (the
        agent calls it while its rendezvous polls): a no-op with an image
        staged; an empty shm is refilled from the backup peer, with the
        engine's staleness rule. ``staged``, ``refilled``, ``stale``,
        ``empty`` or ``unavailable``."""
        if self.shm.read_meta() is not None:
            return "staged"
        if self.replica_manager is None:
            return "unavailable"
        if not self._shard_lock.acquire(timeout=SNAPSHOT_LOCK_S):
            return "unavailable"
        try:
            if self.shm.read_meta() is not None:
                return "staged"
            return self.replica_manager.refill_shm(self.shm, self.storage)
        finally:
            self._shard_lock.release()

    @classmethod
    def prefetch_restore_async(cls) -> Optional[threading.Thread]:
        """:meth:`prefetch_restore` on a thread (the agent calls it just
        before its rendezvous, so the peer fetch overlaps the poll). None
        without a saver yet: a first boot has nothing to prefetch, and the
        worker's engine refills on its own."""
        inst = cls._instance
        if inst is None:
            return None

        def run() -> None:
            try:
                logger.info("agent restore prefetch: %s", inst.prefetch_restore())
            except Exception:  # noqa: BLE001 — an optimisation only
                logger.exception("agent restore prefetch failed")

        t = threading.Thread(target=run, name="restore-prefetch", daemon=True)
        t.start()
        return t

    def wait_durable(self, timeout: float) -> bool:
        """Until the durable writer has drained (and on rank 0 committed)
        what was submitted, at most ``timeout``; True without a writer."""
        writer = self._durable_writer
        return writer is None or writer.wait_idle(timeout)

    def release_replicas(self) -> None:
        """At the end of a job: stop serving replicas and unlink the ones
        held for peers (the job's final state is on storage)."""
        manager, self.replica_manager = self.replica_manager, None
        if manager is not None:
            manager.stop(unlink=True)

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the writer after the write in progress, at most ``timeout``;
        a snapshot not written yet is dropped (the breakpoint save writes
        the staged step before an agent stops). Then the replica server and
        the durable writer."""
        self._running = False
        with self._slot:
            self._slot.notify_all()
        writer = self._writer
        if writer is not None and writer is not threading.current_thread():
            writer.join(timeout)
            if writer.is_alive():
                logger.warning("checkpoint writer still running after %.0f s", timeout)
        pusher = self._replicate_thread
        if pusher is not None and pusher is not threading.current_thread():
            pusher.join(timeout)
        if self.replica_manager is not None:
            self.replica_manager.stop()
        if self._durable_writer is not None:
            self._durable_writer.stop(timeout)

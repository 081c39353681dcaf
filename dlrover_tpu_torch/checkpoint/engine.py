"""Trainer-side checkpoint engine for torch state trees: the port of
``dlrover_tpu/checkpoint/engine.py`` for one process.

``save_to_memory`` stages the state into host shared memory (blocking, or
asynchronously behind a device-side snapshot), ``save_to_storage`` hands
persistence to the agent's saver, and ``load``/``load_consistent`` restore
from memory first, then storage.

Two things differ from the JAX engine because torch state is mutable:

- The train step updates ``state.params`` and the optimizer moments in
  place (``parallel/train_step.py``), and those tensors are the model's
  parameters. A restore therefore copies into the template's own tensors
  (pinned host views, ``non_blocking`` copies, one synchronisation) and
  returns the template's structure holding them, with its Python scalars
  replaced; a restore that returned fresh tensors would leave the model
  training from its old weights.
- The asynchronous save copies every tensor into device buffers the engine
  owns (one ``torch._foreach_copy_`` on the current stream) and records an
  event; the next step's in-place update is queued after the copy, which
  is what donation-safety needs. A staging thread waits on that event on
  its own stream, copies into pinned host buffers the engine allocates
  once, synchronises and copies into shm.

Peer replicas, the durable tier, ``load_resharded`` and agreement between
several processes are not ported yet and raise when asked for.
"""

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common.config import get_context
from ..common.constants import NodeEnv
from ..common.log import logger
from ..common.multi_process import LocalSocketClient, SharedLock, SharedQueue, _ipc_namespace
from ..common.platform import not_ported
from .saver import EVENT_QUEUE, FACTORY_QUEUE, AsyncCheckpointSaver, CheckpointEvent, lock_name
from .shm_handler import (
    SharedMemoryHandler,
    flatten_with_path,
    host_buffer,
    leaf_tensor,
    map_with_path,
    plan_records,
    tensor_bytes,
)
from .storage import PosixCheckpointStorage


def _is_oom(e: BaseException) -> bool:
    return isinstance(e, torch.cuda.OutOfMemoryError) or "out of memory" in repr(e).lower()


def _host_leaf(leaf: Any, arr: torch.Tensor) -> Any:
    """A restored non-tensor leaf of the template's own type."""
    if isinstance(leaf, np.ndarray):
        return arr.numpy().astype(leaf.dtype, copy=True)
    value = arr.item()
    return type(leaf)(value) if isinstance(leaf, (bool, int, float, np.generic)) else value


def restore_into_template(template: Any, arrays: Dict[str, torch.Tensor]) -> Any:
    """Copy ``{path: host tensor}`` into ``template``'s tensors, in place,
    and return the template's structure with its non-tensor leaves (step
    counters) restored. Every path and shape is checked before the first
    copy, so an image that does not fit leaves the template untouched.
    All copies are queued ``non_blocking`` by one ``_foreach_copy_`` and
    followed by one synchronisation per device."""
    flat = flatten_with_path(template)
    for path, leaf in flat:
        if path not in arrays:
            raise KeyError(f"checkpoint missing leaf {path}")
        shape = getattr(leaf, "shape", None)
        if shape is not None and tuple(arrays[path].shape) != tuple(shape):
            raise ValueError(f"leaf {path}: checkpoint shape {tuple(arrays[path].shape)} "
                             f"!= template shape {tuple(shape)}")
    tensors = [(leaf, arrays[path]) for path, leaf in flat if isinstance(leaf, torch.Tensor)]
    if tensors:
        with torch.no_grad():
            torch._foreach_copy_([t for t, _ in tensors], [a for _, a in tensors], non_blocking=True)
    for dev in {t.device for t, _ in tensors if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return map_with_path(
        template, lambda p, leaf: leaf if isinstance(leaf, torch.Tensor) else _host_leaf(leaf, arrays[p])
    )


class CheckpointEngine:
    def __init__(
        self,
        checkpoint_dir: str,
        host_rank: Optional[int] = None,
        num_hosts: Optional[int] = None,
        standalone: Optional[bool] = None,
        replicate: bool = False,
        saver_timeout_s: Optional[float] = None,
        prefetch_restore: Optional[bool] = None,
        durable_dir: Optional[str] = None,
    ):
        self.checkpoint_dir = checkpoint_dir
        if durable_dir is None:
            durable_dir = get_context().durable_dir
        if durable_dir:
            raise not_ported("the durable checkpoint tier")
        if replicate:
            raise not_ported("peer-replica checkpointing")
        self.host_rank = host_rank if host_rank is not None else int(os.getenv(NodeEnv.PROCESS_ID, "0"))
        self.num_hosts = num_hosts if num_hosts is not None else int(os.getenv(NodeEnv.NUM_PROCESSES, "1"))
        if self.num_hosts > 1:
            raise not_ported("checkpoint agreement across processes")
        self.storage = PosixCheckpointStorage(checkpoint_dir)
        self.shm = SharedMemoryHandler(self.host_rank)
        self._latest_storage_step = -1
        # How long to wait for the saver's shard-lock server before
        # declaring its IPC wedged.
        self._saver_timeout_s = (
            saver_timeout_s if saver_timeout_s is not None
            else float(os.getenv("DLROVER_CKPT_SAVER_TIMEOUT_S", "30"))
        )
        if standalone is None:
            standalone = not LocalSocketClient("queue_" + FACTORY_QUEUE).available()
        self._standalone = standalone
        if standalone:
            # no agent supervises this process: run the saver in-process
            AsyncCheckpointSaver.start_async_saving_ckpt()
        # A persist-error marker of a previous incarnation is stale history.
        self.storage.clear_persist_error(self.host_rank)
        self._factory_q = SharedQueue(FACTORY_QUEUE)
        self._event_q = SharedQueue(EVENT_QUEUE)
        self._factory_q.put(self._factory_msg())
        try:
            self._shard_lock = self._wait_lock(self._saver_timeout_s)
        except TimeoutError:
            if self._standalone:
                raise  # our own in-process saver failed: nothing to fall back to
            self._fallback_standalone_saver()
        # async staging state
        self._stage_thread: Optional[threading.Thread] = None
        self._stage_error: Optional[BaseException] = None
        self._stage_stream = None
        # the async snapshot's device buffers and plan, and the host buffer's
        # views it is copied into (see _snapshot, _stage_async)
        self._snap_key = None
        self._snap_bufs: Optional[List[torch.Tensor]] = None
        self._snap_plan = None
        self._snap_host = None
        # No device memory for the snapshot: the first attempt fails with
        # an out-of-memory error and later block=False saves block.
        self._async_disabled = False
        # One host buffer for every copy between device and shm, pinned
        # when a GPU is present; grown only when the state grows.
        self._staging: Optional[torch.Tensor] = None
        # Overlapped restore: the host-side read of a staged image starts
        # now, so it overlaps model build and whatever runs before load().
        self._prefetched: Optional[Tuple[Any, Dict[str, torch.Tensor]]] = None
        self._prefetch_thread: Optional[threading.Thread] = None
        self._prefetch_invalid = False
        self.prefetch_used = False  # the last restore consumed the prefetch
        # rung of the last restore: "prefetch", "memory", "storage" or None
        self.restored_from: Optional[str] = None
        self.stage_failures = 0  # async stages that raised
        if prefetch_restore is None:
            prefetch_restore = get_context().ckpt_prefetch_restore
        if prefetch_restore:
            self._prefetch_thread = threading.Thread(
                target=self._prefetch_restore_host, name="ckpt-restore-prefetch", daemon=True)
            self._prefetch_thread.start()

    def _factory_msg(self) -> Dict:
        return {"type": "create", "storage_root": self.checkpoint_dir,
                "host_rank": self.host_rank, "num_hosts": self.num_hosts}

    def _wait_lock(self, timeout: float) -> SharedLock:
        deadline = time.monotonic() + timeout
        lock = SharedLock(lock_name(self.host_rank))
        while not lock._client.available():
            if time.monotonic() > deadline:
                raise TimeoutError("checkpoint saver did not come up")
            time.sleep(0.05)
        return lock

    def _fallback_standalone_saver(self) -> None:
        """The agent's saver accepted our factory message but its shard-lock
        server never came up: run an in-process saver in a fresh private
        IPC namespace (the wedged namespace's image is given up; storage
        history is not)."""
        fresh_ns = f"{_ipc_namespace()}_fb{os.getpid()}"
        logger.error("checkpoint saver IPC wedged (no shard lock within %.0f s); "
                     "falling back to a standalone saver in namespace %s",
                     self._saver_timeout_s, fresh_ns)
        for res in (self._factory_q, self._event_q):
            res.close()
        self.shm.close()
        os.environ["DLROVER_IPC_NAMESPACE"] = fresh_ns
        self.shm = SharedMemoryHandler(self.host_rank)
        self._standalone = True
        AsyncCheckpointSaver.start_async_saving_ckpt()
        self._factory_q = SharedQueue(FACTORY_QUEUE)
        self._event_q = SharedQueue(EVENT_QUEUE)
        self._factory_q.put(self._factory_msg())
        self._shard_lock = self._wait_lock(self._saver_timeout_s)

    def _host_buffer(self, nbytes: int) -> torch.Tensor:
        self._staging = host_buffer(nbytes, self._staging)
        return self._staging

    # -- overlapped restore ------------------------------------------------

    def _read_staged_host(self, timeout: float = 60.0):
        """(meta, {path: host tensor}) copied out of shm under the shard
        lock, or None when there is no readable image."""
        if not self._shard_lock.acquire(blocking=True, timeout=timeout):
            return None
        try:
            if not self.shm.attach():
                return None
            return self.shm.load_pytree_host(copy=True, staging=self._host_buffer)
        finally:
            self._shard_lock.release()

    def _prefetch_restore_host(self) -> None:
        try:
            self._prefetched = self._read_staged_host(timeout=30.0)
        except Exception as e:  # noqa: BLE001 — an optimisation only
            logger.warning("restore prefetch failed: %s", e)

    def _restore_from_prefetch(self, template: Any, pre) -> Optional[Tuple[int, Any]]:
        if pre is None:
            return None
        meta, arrays = pre
        try:
            restored = restore_into_template(template, arrays)
        except (KeyError, ValueError) as e:
            logger.warning("prefetched image unusable (%s); re-reading", e)
            return None
        self.prefetch_used = True
        self.restored_from = "prefetch"
        logger.info("restored step %s from prefetched host read", meta.step)
        return meta.step, restored

    def _consume_prefetch(self):
        """The prefetch's result: None when disabled, still running, empty,
        or invalidated by a save after it read the segment."""
        t = self._prefetch_thread
        if t is not None:
            t.join(60.0)
            if t.is_alive():
                logger.warning("restore prefetch still running; ignoring its result")
                self._prefetch_invalid = True
            self._prefetch_thread = None
        got, self._prefetched = self._prefetched, None
        return None if self._prefetch_invalid else got

    def _cancel_prefetch(self) -> None:
        # invalid first: a consume after this must not restore the older
        # image; then wait out a read that still holds the shard lock, so
        # the non-blocking acquire of a save does not misread it as a busy
        # persister
        self._prefetch_invalid = True
        self._prefetched = None
        pt = self._prefetch_thread
        if pt is not None and pt.is_alive():
            pt.join(30.0)

    # -- save --------------------------------------------------------------

    def save_to_memory(self, step: int, pytree: Any, extra: Optional[Dict] = None,
                       block: bool = True, for_storage: bool = False) -> bool:
        """Stage the state into host shm. Skips (returns False) while the
        persister holds the shard lock or this engine's previous async stage
        is still in flight (the lock is reentrant per owner, so the
        staging thread would not block a second writer).

        ``block=True`` returns after the copy to shm. ``block=False``
        returns after queuing a device-side snapshot (about one more copy
        of the state in device memory while staging runs; without that
        memory the first attempt fails and this engine blocks from then
        on); a thread stages the snapshot and releases the lock.
        """
        self._cancel_prefetch()
        staging = self.staging_in_flight
        if staging:
            logger.warning("step %s: previous async stage still in flight", step)
        if staging or not self._shard_lock.acquire(blocking=False):
            logger.warning("skip save_to_memory step %s: a persister is busy", step)
            return False
        if not block and self._async_disabled:
            block = True
        if not block:
            try:
                snapshot, event = self._snapshot(pytree)
                t = threading.Thread(target=self._stage_async,
                                     args=(step, snapshot, event, extra, for_storage),
                                     name=f"ckpt-stage-{step}", daemon=True)
                t.start()
                # assigned only after start(): join() on a thread that never
                # started raises
                self._stage_thread = t
                return True
            except Exception as e:
                if not _is_oom(e):
                    self._shard_lock.release()
                    raise
                self._async_disabled = True
                self._snap_bufs = self._snap_key = self._snap_plan = None
                logger.error("snapshot out of memory at step %s; degrading to blocking saves", step)
        try:
            self.shm.save_pytree(step, pytree, num_hosts=self.num_hosts, extra=extra,
                                 staging=self._host_buffer)
            # a blocking save that landed supersedes a stale async failure
            self._stage_error = None
        finally:
            self._shard_lock.release()
        return True

    def _snapshot(self, pytree: Any):
        """Queue the device-side snapshot of ``pytree``: every tensor leaf
        copied by one ``_foreach_copy_`` on the current stream into buffers
        this engine owns. The buffers, their byte views and the payload's
        records are made once and kept while the state keeps its structure.
        Returns ``((records, payload bytes, the buffers' byte views, the
        other leaves as CPU tensors by path), (event recorded after the
        copy, its device))``; the event is None without a GPU tensor."""
        flat = flatten_with_path(pytree)
        tensors = [leaf for _, leaf in flat if isinstance(leaf, torch.Tensor)]
        values = {p: leaf_tensor(leaf) for p, leaf in flat if not isinstance(leaf, torch.Tensor)}
        key = [(p, tuple(leaf.shape), leaf.dtype, leaf.device) if isinstance(leaf, torch.Tensor)
               else (p, tuple(values[p].shape), values[p].dtype) for p, leaf in flat]
        if key != self._snap_key:
            self._snap_key = self._snap_bufs = self._snap_plan = None
            records, _, total = plan_records(pytree)
            self._snap_bufs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in tensors]
            self._snap_plan = (records, total, [tensor_bytes(b) for b in self._snap_bufs])
            self._snap_key = key
        event = None
        if tensors:
            with torch.no_grad():
                torch._foreach_copy_(self._snap_bufs, tensors)
            device = next((t.device for t in tensors if t.is_cuda), None)
            if device is not None:
                event = (torch.cuda.Event(), device)
                event[0].record(torch.cuda.current_stream(device))
        return (*self._snap_plan, values), event

    def _stage_async(self, step: int, snapshot, event, extra, for_storage: bool) -> None:
        """Background half of ``save_to_memory(block=False)``: owns the
        acquired shard lock and always releases it. The snapshot goes to
        the pinned host buffer in one ``_foreach_copy_`` on this engine's
        stream, into views of the buffer made once: each torch call of this
        thread takes the GIL back from the training thread, and a few calls
        per tensor slowed the steps that overlap a stage. A failure
        is sticky in ``_stage_error`` until a stage succeeds or
        ``wait_staged`` consumes it; for a storage save it also leaves a
        persist-error marker so ``wait_saving`` fails fast."""
        try:
            records, total, sources, values = snapshot
            staged = self._host_buffer(total)
            if self._snap_host is None or self._snap_host[0] is not staged or \
                    self._snap_host[1] is not records:
                self._snap_host = (staged, records, [staged[r.offset : r.offset + r.nbytes]
                                                     for r in records if r.path not in values])
            views = self._snap_host[2]
            if event is None:
                torch._foreach_copy_(views, sources)
            else:
                ev, device = event
                with torch.cuda.device(device):
                    if self._stage_stream is None:
                        self._stage_stream = torch.cuda.Stream()
                    self._stage_stream.wait_event(ev)
                    with torch.cuda.stream(self._stage_stream):
                        torch._foreach_copy_(views, sources, non_blocking=True)
                    self._stage_stream.synchronize()
            for rec in records:
                if rec.path in values:
                    staged[rec.offset : rec.offset + rec.nbytes].copy_(tensor_bytes(values[rec.path]))
            self.shm.write_image(step, records, [(0, staged[:total])], num_hosts=self.num_hosts,
                                 extra=extra, background=True)
            self._stage_error = None
        except Exception as e:  # noqa: BLE001 — recorded, surfaced by wait_staged
            self._stage_error = e
            self.stage_failures += 1
            logger.error("async checkpoint staging failed at step %s: %s", step, e)
            if _is_oom(e):
                self._async_disabled = True
            if for_storage:
                try:
                    self.storage.record_persist_error(self.host_rank, step, f"async stage failed: {e!r}")
                except OSError as rec_err:
                    logger.warning("could not record persist error for step %s: %r", step, rec_err)
        finally:
            self._shard_lock.release()

    @property
    def staging_in_flight(self) -> bool:
        """An async stage is still running (the next save will skip)."""
        return self._stage_thread is not None and self._stage_thread.is_alive()

    def wait_staged(self, timeout: float = 300.0) -> bool:
        """Join the outstanding async stage, if any. False if it failed or
        still runs at the deadline. A recorded failure is consumed here."""
        t = self._stage_thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                return False
            self._stage_thread = None
        err, self._stage_error = self._stage_error, None
        return err is None

    def wait_staged_all(self, timeout: float = 300.0) -> bool:
        """``wait_staged`` agreed across processes; one process here."""
        return self.wait_staged(timeout)

    def _drain_stage_for_read(self) -> None:
        """Every restore waits for the staging thread to be dead: a live
        one still writes to the segment through the reentrant lock."""
        t = self._stage_thread
        if t is not None and t.is_alive():
            t.join(300.0)
            if t.is_alive():
                raise RuntimeError("async checkpoint staging is wedged (>300 s); refusing "
                                   "to restore over a live writer on the shm segment")
        self.wait_staged(timeout=0.1)

    def save_to_storage(self, step: int, pytree: Any, extra: Optional[Dict] = None,
                        block: bool = True) -> bool:
        """Stage to memory, then hand persistence to the saver. With
        ``block=False`` the SAVE event is queued while staging still runs:
        the persister takes the shard lock, which the staging thread holds
        until the image is complete."""
        if not self.save_to_memory(step, pytree, extra, block=block, for_storage=True):
            return False
        self._event_q.put({"type": CheckpointEvent.SAVE, "step": step})
        self._latest_storage_step = step
        return True

    def wait_saving(self, timeout: float = 300.0) -> bool:
        """Wait until the queued storage saves are committed. Fails fast
        when the saver recorded a persist error for this shard or its
        event queue is gone (saver process died)."""
        if self._latest_storage_step < 0:
            return True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            latest = self.storage.latest_step()
            # not `latest or -1`: a committed step 0 is falsy
            if latest is not None and latest >= self._latest_storage_step:
                return True
            err = self.storage.persist_error(self.host_rank)
            if err is not None and err[0] >= self._latest_storage_step:
                logger.error("saver reported persist failure at step %s: %s", err[0], err[1])
                return False
            if not self._event_q.available():
                latest = self.storage.latest_step()
                if latest is not None and latest >= self._latest_storage_step:
                    return True
                logger.error("checkpoint saver is gone (event queue unreachable); "
                             "step %s will not be persisted", self._latest_storage_step)
                return False
            time.sleep(0.1)
        return False

    # -- load --------------------------------------------------------------

    def load(self, template: Any) -> Tuple[int, Optional[Any]]:
        """Restore into ``template``: this host's memory first, then
        storage. ``(step, state)``, or ``(-1, None)`` with nothing to load."""
        self._drain_stage_for_read()
        result = self._restore_from_prefetch(template, self._consume_prefetch())
        if result is None:
            result = self._load_from_memory(template)
        if result is None:
            result = self._load_from_storage(template)
        return result if result is not None else (-1, None)

    def load_resharded(self, mesh, step: Optional[int] = None):
        raise not_ported("templateless resharded restore")

    def _load_from_memory(self, template: Any):
        # Under the shard lock: the persister or a dying trainer's last
        # save may be writing. The image is copied out of the segment (no
        # view of it outlives the lock).
        got = self._read_staged_host()
        if got is None:
            return None
        meta, arrays = got
        try:
            restored = restore_into_template(template, arrays)
        except (KeyError, ValueError) as e:
            logger.warning("memory checkpoint unusable (%s); trying storage", e)
            return None
        self.restored_from = "memory"
        logger.info("restored step %s from host memory", meta.step)
        return meta.step, restored

    def _load_from_storage(self, template: Any, step: Optional[int] = None):
        if step is None:
            step = self.storage.latest_step()
        if step is None:
            return None
        arrays = self.storage.load_step_host(step)
        if arrays is None:
            return None
        try:
            restored = restore_into_template(template, arrays)
        except (KeyError, ValueError) as e:
            logger.warning("storage checkpoint step %s unusable (%s); starting fresh", step, e)
            return None
        self.restored_from = "storage"
        logger.info("restored step %s from storage %s", step, self.checkpoint_dir)
        return step, restored

    # Floor for how many of the newest committed steps enter the agreement;
    # always above ckpt_keep_latest so pruning cannot hide a common step.
    RESTORE_CANDIDATE_STEPS = 8

    def _gather_restore_meta(self, mem_step: int, tracker_step: int, committed: List[int]):
        """Every process's (staged shm step, storage tracker step, committed
        step set). One process: its own row."""
        k = max(self.RESTORE_CANDIDATE_STEPS, get_context().ckpt_keep_latest + 2)
        return [mem_step], [tracker_step], [set(sorted(committed)[-k:])]

    def load_consistent(self, template: Any) -> Tuple[int, Optional[Any]]:
        """``load`` with the cross-process agreement on the restore source:
        every process staged the same memory step, then memory; otherwise
        the newest step committed everywhere, capped at the newest tracker
        (a stale high step left in a reused root must not shadow the live
        history); no common step, a fresh start."""
        self._drain_stage_for_read()
        pre = self._consume_prefetch()
        if pre is not None:
            meta = pre[0]
        else:
            meta = self.shm.read_meta() if self.shm.attach() else None
        mem_step = -1 if meta is None else meta.step
        latest = self.storage.latest_step()
        mem_steps, st_steps, committed_sets = self._gather_restore_meta(
            mem_step, -1 if latest is None else latest, self.storage.list_steps())
        if mem_steps[0] >= 0 and len(set(mem_steps)) == 1:
            if pre is not None and pre[0].step == mem_steps[0]:
                result = self._restore_from_prefetch(template, pre)
                if result is not None:
                    return result
            result = self._load_from_memory(template)
            if result is not None:
                return result
        common = set.intersection(*committed_sets) if committed_sets else set()
        cap = max(st_steps)
        candidates = {s for s in common if cap < 0 or s <= cap}
        target = max(candidates) if candidates else -1
        if len(set(mem_steps)) != 1 or mem_steps[0] < 0:
            logger.info("staged steps %s not uniformly restorable (trackers %s, common committed %s); "
                        "restoring step %s", mem_steps, st_steps, sorted(common), target)
        if target < 0:
            return -1, None
        result = self._load_from_storage(template, step=target)
        if result is None:
            raise RuntimeError(f"agreed checkpoint step {target} unreadable from storage")
        return result

    def close(self) -> None:
        """Release IPC clients and the shm mapping; a standalone engine also
        shuts its in-process saver down."""
        self._cancel_prefetch()
        self._prefetch_thread = None
        t = self._stage_thread
        if t is not None and t.is_alive():
            t.join(60.0)
            if t.is_alive():
                # a wedged stage still writes through shm and the lock;
                # closing them under it trades a leak for corruption
                logger.error("async stage still running after 60 s; leaving shm/lock open")
                return
        self.wait_staged(timeout=0.1)
        for res in (self._event_q, self._factory_q, self._shard_lock, self.shm):
            res.close()
        if self._standalone:
            AsyncCheckpointSaver.shutdown()

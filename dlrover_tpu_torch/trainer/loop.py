"""ElasticTrainLoop: the port of ``dlrover_tpu/trainer/loop.py``.

Fixed global batch through world-size-aware gradient accumulation,
consistent resume through ``CheckpointEngine.load_consistent``, a
shared-memory stage every ``memory_every`` steps and an asynchronous
storage persist every ``storage_every`` steps, a cooperative stop at a
step boundary, and a final stage with retries, so a successor resumes
exactly where a run stopped.

Not ported yet, and raising when asked for rather than silently ignored:
soft re-mesh, the replanner, compile-ahead, the device monitor, the host
tracer and the native step marks (``DLROVER_TT_PORT``). Events, metrics
and the recovery spool wait for the observability slice.
"""

import os
import threading
import time
from typing import Any, Callable, Iterable, Optional, Tuple

import torch

from ..common.config import get_context
from ..common.log import logger
from ..common.platform import not_ported


def gradient_accumulation_steps(max_workers: int, current_workers: int) -> int:
    """Accumulation factor keeping the global batch fixed as the world
    shrinks: with max 8 workers and 2 alive, each does 4 slices per
    optimizer step. Non-divisible worlds round up (the global batch grows
    slightly rather than shrinking)."""
    if current_workers <= 0 or max_workers <= current_workers:
        return 1
    if max_workers % current_workers:
        return -(-max_workers // current_workers)
    return max_workers // current_workers


def _sync(loss) -> None:
    """Wait for the step that produced ``loss`` to finish on its device."""
    if isinstance(loss, torch.Tensor) and loss.is_cuda:
        torch.cuda.synchronize(loss.device)


class ElasticTrainLoop:
    """Drives ``step_fn(state, *batch) -> (state, loss)`` with elastic
    resume and checkpoint cadence.

    >>> loop = ElasticTrainLoop(engine, step_fn, max_steps=10_000, storage_every=200)
    >>> state = loop.run(state, data_factory=lambda start: batches_from(start))
    """

    def __init__(
        self,
        engine,
        step_fn: Callable,
        ctx=None,
        max_steps: int = 0,
        memory_every: int = 1,
        storage_every: int = 100,
        log_every: int = 10,
        on_step: Optional[Callable[[int, Any], None]] = None,
        device_monitor: bool = False,
        trace_host: bool = False,
        soft_remesh: bool = False,
        on_remesh: Optional[Callable] = None,
        prefetch_input: Optional[bool] = None,
        input_stage_fn: Optional[Callable[[Tuple], Tuple]] = None,
        input_device=None,
        compile_ahead=None,
        replanner=None,
        on_replan: Optional[Callable] = None,
    ):
        for asked, what in (
            (device_monitor, "the device monitor"),
            (trace_host, "the host tracer"),
            (soft_remesh or on_remesh is not None, "soft re-mesh"),
            (compile_ahead is not None, "compile-ahead"),
            (replanner is not None or on_replan is not None, "the elastic replanner"),
            (bool(os.environ.get("DLROVER_TT_PORT")), "native step marks (DLROVER_TT_PORT)"),
        ):
            if asked:
                raise not_ported(what)
        self.engine = engine
        self.step_fn = step_fn
        self.ctx = ctx
        self.max_steps = max_steps
        self.memory_every = max(1, memory_every)
        # 0 disables storage persistence (shm staging only)
        self.storage_every = max(0, storage_every)
        self.log_every = max(1, log_every)
        self.on_step = on_step
        self.start_step = 0
        # None defers to the Context knob (DLROVER_INPUT_PREFETCH)
        self._prefetch_input = prefetch_input
        self._input_stage_fn = input_stage_fn
        self._input_device = input_device
        # wall time of the phases of a (re)start this process owns
        self.last_restore_s = 0.0
        self.last_first_step_s = 0.0
        self.last_compile_s: Optional[float] = None
        # Cooperative stop at the next step boundary: the loop stages the
        # final step before it returns. One-shot per loop instance.
        self._stop_requested = threading.Event()

    def request_stop(self) -> None:
        """Ask a running :meth:`run` to stop at the next step boundary
        (callable from any thread)."""
        self._stop_requested.set()

    @property
    def stop_requested(self) -> bool:
        return self._stop_requested.is_set()

    def restore(self, state: Any) -> Tuple[int, Any]:
        """(start_step, state), the restore source agreed by
        ``load_consistent``: shared memory, then storage."""
        t0 = time.monotonic()
        loaded, restored = self.engine.load_consistent(state)
        self.last_restore_s = time.monotonic() - t0
        if loaded >= 0 and restored is not None:
            logger.info("resuming from step %s (restore %.2fs)", loaded, self.last_restore_s)
            self.start_step = loaded + 1
            return self.start_step, restored
        self.start_step = 0
        return 0, state

    def run(self, state: Any, data_iter: Optional[Iterable[Tuple]] = None,
            data_factory: Optional[Callable[[int], Iterable[Tuple]]] = None) -> Any:
        """Train until ``max_steps`` or the data ends.

        ``data_factory(start)`` is called after the restore with the step to
        resume at and returns an iterator positioned there; a plain
        ``data_iter`` suits only stateless sources (a sequential one would
        replay its first batches after a resume).
        """
        start, state = self.restore(state)
        if data_factory is not None:
            data_iter = data_factory(start)
        if data_iter is None:
            raise ValueError("run() needs data_iter or data_factory")
        prefetch = self._prefetch_input
        if prefetch is None:
            prefetch = get_context().input_prefetch
        prefetcher = None
        if prefetch:
            from .dataloader import PrefetchIterator

            data_iter = prefetcher = PrefetchIterator(
                data_iter, stage_fn=self._input_stage_fn, device=self._input_device)
        elif self._input_stage_fn is not None:
            stage = self._input_stage_fn
            data_iter = (stage(batch) for batch in data_iter)
        try:
            return self._run_inner(state, data_iter, start)
        finally:
            if prefetcher is not None:
                prefetcher.close()

    def _record_boot_step(self, idx: int, loss, t0: float) -> None:
        """Time the first two steps after a (re)start: the first carries the
        warm-up, the second is steady, and their difference is
        ``last_compile_s``. Synchronises the device on these two steps
        only."""
        _sync(loss)
        dt = time.monotonic() - t0
        if idx == 0:
            self.last_first_step_s = dt
        else:
            self.last_compile_s = max(0.0, self.last_first_step_s - dt)

    def _run_inner(self, state, data_iter, start):
        step = start
        last_save_ok = False
        it = iter(data_iter)
        while True:
            # bound check before drawing: a resume at max_steps must not
            # consume an element of a finite source
            if self.max_steps and step >= self.max_steps:
                break
            if self._stop_requested.is_set():
                break
            try:
                batch = next(it)
            except StopIteration:
                break
            if self.ctx is not None:
                self.ctx.start_step_timer()
            timed = step - start < 2
            t_step0 = time.monotonic() if timed else 0.0
            state, loss = self.step_fn(state, *batch)
            if timed:
                self._record_boot_step(step - start, loss, t_step0)
            # Cadence saves stage asynchronously (device-side snapshot and a
            # background copy to shm), so the step blocks only to queue the
            # snapshot.
            if self.storage_every and step % self.storage_every == 0:
                last_save_ok = self.engine.save_to_storage(step, state, block=False)
            elif step % self.memory_every == 0:
                last_save_ok = self.engine.save_to_memory(step, state, block=False)
            else:
                last_save_ok = False
            if self.ctx is not None:
                self.ctx.report_step(step)
            if self.on_step is not None:
                self.on_step(step, loss)
            if step % self.log_every == 0:
                # a scalar fetch only at log cadence: a per-step float()
                # would serialise host and device
                logger.info("step %s: loss %.4f", step, float(loss))
            step += 1
        if last_save_ok and not self.engine.wait_staged_all():
            last_save_ok = False  # the async stage failed: stage again below
        if step > start and not last_save_ok:
            # In-loop saves skip while the persister holds the shard lock;
            # stage the final state with retries so a resume continues
            # exactly here. Bounded by attempt count.
            for _ in range(300):
                if self.engine.save_to_memory(step - 1, state):
                    break
                time.sleep(0.1)
            else:
                logger.warning("could not stage the final step %s", step - 1)
        if not self.engine.wait_saving():
            logger.warning("pending checkpoint persists did not complete")
        return state

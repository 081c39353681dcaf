"""The per-host elastic training agent: the port of
``dlrover_tpu/agent/training_agent.py``.

The agent reaps a dead predecessor's worker, starts the checkpoint saver
(the worker's engine stages to shared memory, the saver in this process
persists it, and in a world of several hosts serves the peer's replica and
pushes this host's), joins the rendezvous (with the saver refilling an
empty shm from the peer meanwhile, as the JAX agent does) and starts the
worker with the world's env contract, then supervises it:

- a failed worker: the staged step is persisted at once (the breakpoint
  save, ``save_shm_to_storage``), the failure is diagnosed and reported,
  and the worker is restarted on this host through a new rendezvous while
  the restart budget lasts, else the agent exits for a relaunch;
- waiters at the master (a membership change): the worker is restarted
  into the new world;
- master actions delivered on heartbeats: restart, relaunch, abort;
- a succeeded worker: the agent lets the saver's durable writer drain
  (bounded; the JAX agent does not wait, and its last generation's commit
  barrier can outlive the master), reports success, passes the bounded exit
  barrier, persists the last staged step and releases the job's shared
  memory, the replicas it holds for peers included.

The agent keeps one warm spare (``warm_spare``, on by default as in the
JAX package): a pre-imported interpreter spawned when the agent starts and
again ``SPARE_SPAWN_DELAY_S`` after each worker start that left the agent
without one, which the next worker start adopts. It is killed on every way out of
:meth:`run`. One thing differs from the JAX agent: a restart waits up to
2 s for a spare that is not ready yet, but the first start takes the
initial spare only if it is ready by then. With a rendezvous that forms at
once (one node) the JAX agent's 2 s wait holds the first worker back, is
too short for the imports, and when it is long enough it leaves the job
without a spare for ``SPARE_SPAWN_DELAY_S`` plus the imports.

The agent holds no CUDA context: it never touches ``torch.cuda``; the
worker owns the GPU. Soft re-mesh, profiling and stack dumps, the metrics
server, the resource monitor, master re-attach, events and chaos hooks wait
for later slices and raise when they are configured.
"""

import json
import os
import threading
import time
from typing import Dict, Optional

from ..checkpoint.saver import AsyncCheckpointSaver
from ..checkpoint.shm_handler import SharedMemoryHandler
from ..common import multi_process
from ..common.config import get_context
from ..common.constants import NodeEnv, NodeExitReason, NodeStatus, RendezvousName
from ..common.log import logger
from ..common.platform import not_ported
from ..master.diagnosis.action import DiagnosisActionType
from ..rpc.client import MasterClient
from .config import ElasticLaunchConfig
from .diagnosis_agent import DiagnosisAgent, WorkerFailure
from .rendezvous import MasterRendezvousHandler, RendezvousWorld
from .worker import (RunResult, WarmSpare, WorkerProcess, WorkerSpec, WorkerState,
                     reap_stale_workers)

AGENT_EXIT_OK = 0
# nonzero asks the platform (the master) to replace this node
AGENT_EXIT_RELAUNCH = 1
AGENT_EXIT_FATAL = 2

# The agent logs one line per recovery, "agent recovery: {json}", with the
# wall-clock stamps of its phases and its reason, "worker failure" or
# "membership" (read by chip_smoke.py's tpurun and two-node phases).
RECOVERY_LOG_PREFIX = "agent recovery: "


def _not_ported_features(config: ElasticLaunchConfig):
    return (
        (config.soft_remesh, "soft re-mesh"),
        (config.profile_enabled(), "native profiling (--profile on)"),
        (config.numa_affinity, "NUMA affinity (--numa-affinity)"),
        (bool(config.compile_cache_dir), "the compile cache (--compile-cache-dir)"),
        (config.network_check, "the node network check (--network-check)"),
        (config.auto_tunning, "auto-tuning (--auto_tunning)"),
        (config.exclude_straggler, "straggler exclusion (--exclude-straggler)"),
        (bool(os.environ.get("DLROVER_METRICS_AGENT_PORT")),
         "the agent metrics server (DLROVER_METRICS_AGENT_PORT)"),
        (bool(os.environ.get("DLROVER_FAULT_PLAN")), "chaos hooks (DLROVER_FAULT_PLAN)"),
        (bool(os.environ.get("DLROVER_EVENT_DIR")), "events (DLROVER_EVENT_DIR)"),
    )


class ElasticTrainingAgent:
    def __init__(self, config: ElasticLaunchConfig, spec: Optional[WorkerSpec] = None,
                 client: Optional[MasterClient] = None, start_ckpt_saver: bool = True):
        for asked, what in _not_ported_features(config):
            if asked:
                raise not_ported(what)
        self._config = config
        self._client = client or MasterClient.singleton()
        self._spec = spec or WorkerSpec(entrypoint=config.entrypoint, args=config.entry_args,
                                        run_module=config.run_module, env=config.worker_env(),
                                        log_dir=config.log_dir)
        # The saver (here) and the engine (in the worker) must meet: the
        # worker gets this process's socket directory and IPC namespace.
        self._spec.env.setdefault("DLROVER_IPC_DIR", multi_process.SOCKET_TMP_DIR)
        self._spec.env.setdefault("DLROVER_IPC_NAMESPACE", multi_process._ipc_namespace())
        self._rdzv_handler = MasterRendezvousHandler(
            RendezvousName.TRAINING, node_rank=config.node_rank, client=self._client,
            node_id=config.node_id, local_world_size=config.local_world_size,
            rdzv_timeout=config.rdzv_timeout, training_port=config.training_port,
            slice_id=config.slice_id())
        self._diagnosis = DiagnosisAgent(config.node_id, client=self._client,
                                         max_restarts=config.max_restarts,
                                         heartbeat_interval=get_context().heartbeat_interval_s)
        self._worker: Optional[WorkerProcess] = None
        self._world: Optional[RendezvousWorld] = None
        self._remaining_restarts = config.max_restarts
        self._restart_count = 0
        self._start_ckpt_saver = start_ckpt_saver
        self._stopped = threading.Event()
        self._pending_action: Optional[str] = None
        self._action_lock = threading.Lock()
        self._diagnosis.register_action_handler(self._on_master_action)
        # wall-clock stamps of the last recovery (see RECOVERY_LOG_PREFIX)
        self.last_recovery: Dict[str, float] = {}
        self._last_rdzv_s = 0.0
        self._last_start = "cold"  # how the current worker started
        self._spare: Optional[WarmSpare] = None
        # guards _spare against the deferred spawn's thread
        self._spare_lock = threading.Lock()

    # -- lifecycle --------------------------------------------------------

    def run(self) -> int:
        # a hard-killed predecessor's worker may still hold the GPU and shm
        reap_stale_workers()
        if self._start_ckpt_saver:
            AsyncCheckpointSaver.start_async_saving_ckpt()
        self._diagnosis.start_heartbeat()
        code = AGENT_EXIT_FATAL
        try:
            # the first spare at once: its imports race the rendezvous, so
            # even the first worker start may adopt it
            self._replenish_spare(delay_s=0.0)
            self._initialize_workers()
            code = self._invoke_run()
            return code
        finally:
            # set before the spare is killed: a deferred spawn checks it
            self._stopped.set()
            self._diagnosis.stop()
            self._kill_spare("the agent stops")
            if self._worker is not None:
                self._worker.stop()
            if self._start_ckpt_saver:
                if code == AGENT_EXIT_OK:
                    self._release_checkpoint_shm()
                AsyncCheckpointSaver.shutdown()

    def stop(self) -> None:
        self._stopped.set()

    def _release_checkpoint_shm(self) -> None:
        """After a successful job: persist the last staged step (the final
        state outlives the segment) and unlink the job's segment. A failed
        run keeps it, so a rerun under the same job name resumes from
        memory."""
        saver = AsyncCheckpointSaver._instance
        try:
            if saver is not None:
                if saver.save_shm_to_storage():
                    logger.info("final staged step persisted")
                saver.shm.unlink()
                saver.release_replicas()
            else:
                SharedMemoryHandler(self._world.rank if self._world else 0).unlink()
        except Exception as e:  # noqa: BLE001 — the job has ended either way
            logger.warning("releasing the checkpoint segment failed: %s", e)

    # -- worker management ------------------------------------------------

    def _initialize_workers(self) -> None:
        """Rendezvous (the handler retries until its deadline), then start
        the worker with the world's env."""
        # the saver refills an empty shm from the peer's replica while the
        # rendezvous polls, so the worker's restore finds it staged
        AsyncCheckpointSaver.prefetch_restore_async()
        t0 = time.time()
        self._world = self._rdzv_handler.next_rendezvous()
        self._last_rdzv_s = time.time() - t0
        logger.info("world ready: round=%s rank=%s/%s coordinator=%s (rendezvous %.3f s)",
                    self._world.round, self._world.rank, self._world.world_size,
                    self._world.coordinator, self._last_rdzv_s)
        first = self._worker is None
        self._worker = WorkerProcess(self._spec, restart_count=self._restart_count)
        spare = self._take_spare()
        self._last_start = self._worker.start(dynamic_env=self._world_env(self._world),
                                              spare=spare, spare_wait_s=0.0 if first else 2.0)
        if self._last_start != "warm" and spare is not None:
            if spare.proc.poll() is None:
                with self._spare_lock:  # not ready yet: keep it for the next start
                    if self._spare is None and not self._stopped.is_set():
                        self._spare, spare = spare, None
            if spare is not None:
                spare.kill("not adopted and not kept")
        self._replenish_spare()
        self._report_status(NodeStatus.RUNNING)

    def _world_env(self, world: RendezvousWorld) -> Dict[str, str]:
        """The per-round part of the env contract."""
        return {
            NodeEnv.COORDINATOR_ADDRESS: world.coordinator,
            NodeEnv.NUM_PROCESSES: str(world.world_size),
            NodeEnv.PROCESS_ID: str(world.rank),
            NodeEnv.NODE_RANK: str(self._config.node_rank),
            NodeEnv.NODE_NUM: str(world.world_size),
        }

    def _restart_workers(self, reason: str) -> None:
        logger.info("restarting worker (%s)", reason)
        if self._worker is not None:
            self._worker.stop()
        self._restart_count += 1
        self._initialize_workers()

    # -- monitor loop -----------------------------------------------------

    def _invoke_run(self) -> int:
        while not self._stopped.wait(self._config.monitor_interval):
            action = self._take_pending_action()
            if action is not None:
                code = self._apply_master_action(action)
                if code is not None:
                    return code
                continue
            result = self._worker.poll()
            if result.state == WorkerState.SUCCEEDED:
                self._drain_durable()
                self._report_status(NodeStatus.SUCCEEDED)
                self._exit_barrier()
                return AGENT_EXIT_OK
            if result.state == WorkerState.FAILED:
                code = self._handle_worker_failure(result)
                if code is not None:
                    return code
                continue
            if self._membership_changed():
                rec = {"reason": "membership", "detected": time.time(), "pid": self._worker.pid,
                       "restart_count": self._restart_count}
                rec["persisted"] = rec["detected"]  # no breakpoint save: the worker was alive
                self._restart_workers("membership changed")
                self._log_recovery(rec)
        return AGENT_EXIT_OK

    def _handle_worker_failure(self, result: RunResult) -> Optional[int]:
        """Breakpoint save, diagnose, restart or relaunch."""
        rec = {"reason": "worker failure", "detected": time.time(), "pid": self._worker.pid,
               "returncode": result.returncode, "signal": result.signal,
               "restart_count": self._restart_count}
        logger.error("worker failed rc=%s signal=%s restart=%s", result.returncode,
                     result.signal, self._restart_count)
        if self._config.save_at_breakpoint:
            rec["persisted_step"] = self._save_ckpt_at_breakpoint()
        rec["persisted"] = time.time()
        failure = WorkerFailure(node_rank=self._config.node_rank,
                                restart_count=self._restart_count,
                                returncode=result.returncode, signal=result.signal,
                                log_tail=self._worker.tail_log())
        self._diagnosis.report_failure(failure)
        action = self._diagnosis.diagnose_training_failure(failure)
        rec["action"] = action
        if action == DiagnosisActionType.RESTART_WORKER and self._remaining_restarts > 0:
            self._remaining_restarts -= 1
            self._restart_workers("worker failure")
            self._log_recovery(rec)
            return None
        logger.info("%s%s", RECOVERY_LOG_PREFIX, json.dumps(rec))
        # RELAUNCH_REQUESTED, not FATAL_ERROR: this exit is the agent asking
        # the master for a replacement node
        self._report_status(NodeStatus.FAILED, exit_reason=NodeExitReason.RELAUNCH_REQUESTED)
        logger.error("worker failure unrecoverable on this node; relaunching")
        return AGENT_EXIT_RELAUNCH

    def _log_recovery(self, rec: Dict) -> None:
        """Complete ``rec`` with the restarted worker and log it."""
        rec.update(respawned=self._worker.start_time, new_pid=self._worker.pid,
                   rdzv_s=self._last_rdzv_s, how=self._last_start)
        self.last_recovery = rec
        logger.info("%s%s", RECOVERY_LOG_PREFIX, json.dumps(rec))

    def _membership_changed(self) -> bool:
        """True when the master has waiters that require a new world (the
        master applies the node-unit rules)."""
        try:
            return self._rdzv_handler.num_nodes_waiting() > 0
        except Exception as e:  # noqa: BLE001 — a dark master is the orphan guard's
            logger.warning("num_nodes_waiting failed: %s", e)
            return False

    # -- master-issued actions -------------------------------------------

    def _on_master_action(self, action_type: str, config: dict) -> None:
        if action_type == DiagnosisActionType.STACK_DUMP:
            logger.warning("stack dumps are not ported; ignoring the master's request")
            return
        with self._action_lock:
            self._pending_action = action_type

    def _take_pending_action(self) -> Optional[str]:
        with self._action_lock:
            action, self._pending_action = self._pending_action, None
            return action

    def _apply_master_action(self, action: str) -> Optional[int]:
        if action == DiagnosisActionType.RESTART_WORKER:
            self._restart_workers("master-issued restart")
            return None
        if action == DiagnosisActionType.RELAUNCH_WORKER:
            self._worker.stop()
            self._report_status(NodeStatus.FAILED, exit_reason="relaunched")
            return AGENT_EXIT_RELAUNCH
        if action == DiagnosisActionType.JOB_ABORTION:
            self._worker.stop()
            self._report_status(NodeStatus.FAILED, exit_reason="job_aborted")
            return AGENT_EXIT_FATAL
        return None

    # -- the warm spare (one pre-imported interpreter per agent) ----------

    # The spawn after a worker start is deferred off the recovery's critical
    # path: the spare's imports would compete with the new worker's boot for
    # the host's CPU at the moment the time to recover is measured.
    SPARE_SPAWN_DELAY_S = 8.0

    def _take_spare(self) -> Optional[WarmSpare]:
        with self._spare_lock:
            spare, self._spare = self._spare, None
            return spare

    def _kill_spare(self, reason: str) -> None:
        spare = self._take_spare()
        if spare is not None:
            spare.kill(reason)

    def _replenish_spare(self, delay_s: Optional[float] = None) -> None:
        """Keep one warm spare on deck: spawned after ``delay_s`` (by default
        ``SPARE_SPAWN_DELAY_S``), at once when the agent starts."""
        with self._spare_lock:
            if not self._config.warm_spare or self._spare is not None:
                return

        def spawn():
            with self._spare_lock:
                # under the lock: a stop that set the flag first kills no
                # spare spawned after its cleanup
                if self._spare is not None or self._stopped.is_set():
                    return
                try:
                    self._spare = WarmSpare(self._spec)
                except Exception as e:  # noqa: BLE001 — an optimization only
                    logger.warning("warm spare spawn failed: %s", e)

        if delay_s is None:
            delay_s = self.SPARE_SPAWN_DELAY_S
        if delay_s <= 0:
            spawn()
            return
        timer = threading.Timer(delay_s, spawn)
        timer.daemon = True
        timer.start()

    # -- helpers ----------------------------------------------------------

    def _save_ckpt_at_breakpoint(self) -> int:
        """Persist whatever step is staged in shm before the restart; the
        staged step, or -1 when nothing was persisted."""
        saver = AsyncCheckpointSaver._instance
        if saver is None:
            return -1
        try:
            meta = saver.shm.read_meta()
            if meta is not None and saver.save_shm_to_storage():
                logger.info("breakpoint checkpoint of step %s persisted", meta.step)
                return meta.step
        except Exception as e:  # noqa: BLE001 — the restart goes on without it
            logger.warning("breakpoint save failed: %s", e)
        return -1

    def _report_status(self, status: str, exit_reason: str = "") -> None:
        try:
            self._client.report_node_status(status, exit_reason=exit_reason,
                                            restart_count=self._restart_count)
        except Exception as e:  # noqa: BLE001
            logger.warning("status report failed: %s", e)

    def _drain_durable(self, timeout: float = 300.0) -> None:
        """Before the success report: let the saver's durable writer drain
        the steps the worker persisted, so the last generation's commit
        barrier (a counter at the master) runs while the master is up; the
        master ends the job once every node reports success."""
        saver = AsyncCheckpointSaver._instance
        if saver is not None and not saver.wait_durable(timeout):
            logger.warning("durable writer still draining after %.0f s", timeout)

    def _exit_barrier(self, timeout: float = 300.0) -> None:
        """Every agent of the world waits here, at most ``timeout``, so the
        slower ones finish persisting before the job is torn down."""
        if self._world is None or self._world.world_size <= 1:
            return
        key = f"exit_barrier/{self._world.round}"
        try:
            count = self._client.kv_store_add(key, 1)
            deadline = time.time() + timeout
            while count < self._world.world_size and time.time() < deadline:
                time.sleep(0.5)
                count = self._client.kv_store_add(key, 0)
        except Exception as e:  # noqa: BLE001
            logger.warning("exit barrier failed: %s", e)

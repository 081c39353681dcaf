"""Standalone job master: the port of ``dlrover_tpu/master/local_master.py``.

Composes the job manager, the training rendezvous, the KV store and the
step monitor behind the HTTP servicer, and runs the supervision loop: a
job abortion from the master's action queue ends the job, and so does the
exit of every worker (``SUCCEEDED`` when all succeeded, else
``FATAL_ERROR``). Master persistence (the state journal and the boot
epoch), the dataset task manager, the sync service, events and the
network-check rendezvous wait for the slices that port them.
"""

import os
import threading
from typing import Dict, Optional

from ..common.config import get_context
from ..common.constants import JobExitReason, JobStage, PreCheckStatus, RendezvousName
from ..common.log import logger
from ..common.platform import not_ported
from ..rpc.server import create_master_server
from .diagnosis.action import DiagnosisActionType
from .job_context import JobContext, get_job_context
from .kv_store import KVStoreService
from .monitor.perf_monitor import PerfMonitor
from .node.job_manager import JobManager
from .rdzv.manager import ElasticTrainingRendezvousManager, RendezvousManager
from .servicer import MasterServicer

# how often the supervision loop looks at the job
RUN_POLL_S = 1.0


class LocalJobMaster:
    def __init__(self, port: int = 0, num_workers: int = 1, node_unit: int = 1,
                 service_type: str = "", fresh_context: bool = True):
        ctx = get_context()
        if os.environ.get("DLROVER_MASTER_STATE_DIR"):
            raise not_ported("master persistence and re-attach (DLROVER_MASTER_STATE_DIR)")
        if fresh_context:
            JobContext.reset()
        self._job_ctx = get_job_context()
        self.job_manager = JobManager(num_workers=num_workers)
        training_rdzv = ElasticTrainingRendezvousManager()
        training_rdzv.update_rdzv_params(min_nodes=1, max_nodes=num_workers,
                                         waiting_timeout=ctx.rdzv_timeout_s, node_unit=node_unit)
        self.rdzv_managers: Dict[str, RendezvousManager] = {RendezvousName.TRAINING: training_rdzv}
        self.kv_store = KVStoreService()
        self.perf_monitor = PerfMonitor()
        self.servicer = MasterServicer(job_manager=self.job_manager,
                                       rdzv_managers=self.rdzv_managers,
                                       kv_store=self.kv_store, perf_monitor=self.perf_monitor)
        self._server, self.port = create_master_server(
            self.servicer, service_type or ctx.master_comms(), port)
        self._run_thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        self.exit_reason = ""

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    def prepare(self) -> None:
        self._server.start()
        self.job_manager.start()
        # the standalone master runs no scheduling pre-check: agents
        # waiting on it proceed
        self._job_ctx.pre_check_status = PreCheckStatus.PASSED
        self._job_ctx.set_stage(JobStage.RUNNING)

    def run_in_background(self) -> None:
        self._run_thread = threading.Thread(target=self.run, name="master-run", daemon=True)
        self._run_thread.start()

    def run(self) -> None:
        """Supervision loop: returns when the job has ended or on stop()."""
        while not self._stopped.wait(RUN_POLL_S):
            try:
                action = self._job_ctx.master_actions.next_action(-1)
                if action.action_type == DiagnosisActionType.JOB_ABORTION:
                    self._exit(action.config.get("reason", JobExitReason.FATAL_ERROR))
                    return
                if self.job_manager.all_workers_exited():
                    if self.job_manager.all_workers_succeeded():
                        self._exit(JobExitReason.SUCCEEDED)
                    else:
                        self._exit(JobExitReason.FATAL_ERROR)
                    return
            except Exception:  # noqa: BLE001 — the loop outlives one bad pass
                logger.exception("master run loop error")

    def _exit(self, reason: str) -> None:
        self.exit_reason = reason
        self._job_ctx.set_stage(JobStage.STOPPED, reason)
        logger.info("job master exiting: %s", reason)
        self._stopped.set()

    def stop(self) -> None:
        self._stopped.set()
        self.job_manager.stop()
        self._server.stop()


def run_local_master(port: int = 0, num_workers: int = 1, node_unit: int = 1,
                     service_type: str = "") -> LocalJobMaster:
    master = LocalJobMaster(port=port, num_workers=num_workers, node_unit=node_unit,
                            service_type=service_type)
    master.prepare()
    master.run_in_background()
    return master

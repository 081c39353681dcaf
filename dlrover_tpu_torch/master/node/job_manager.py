"""Node management: the port of ``dlrover_tpu/master/node/job_manager.py``.

The node table, status and failure reports from the agents, the relaunch
decision (delivered to the agent as a diagnosis action: the standalone
master has no scheduler to replace a host), the dead-node check from
heartbeats, and the exit verdicts ``all_workers_exited`` and
``all_workers_succeeded``. Platform watcher events wait for the slice that
ports the distributed master.
"""

import threading
import time
from typing import List, Optional

from ...common.config import get_context
from ...common.constants import JobExitReason, NodeExitReason, NodeStatus, NodeType
from ...common.log import logger
from ...common.node import Node
from ..diagnosis.action import DiagnosisActionType, JobAbortionAction, NodeAction
from ..job_context import get_job_context


class JobManager:
    def __init__(self, num_workers: int = 1):
        self._ctx = get_context()
        self._job_ctx = get_job_context()
        self.num_workers = num_workers
        self._stopped = threading.Event()
        self._monitor_thread: Optional[threading.Thread] = None

    def start(self) -> None:
        for node_id in range(self.num_workers):
            if self._job_ctx.get_node(NodeType.WORKER, node_id) is None:
                self._job_ctx.update_node(Node(node_type=NodeType.WORKER, node_id=node_id,
                                               rank_index=node_id,
                                               max_relaunch_count=self._ctx.max_relaunch_count))
        self._monitor_thread = threading.Thread(target=self._monitor_heartbeats,
                                                name="heartbeat-monitor", daemon=True)
        self._monitor_thread.start()

    def stop(self) -> None:
        self._stopped.set()

    # -- status reports from agents ---------------------------------------

    def update_node_status(self, node_id: int, node_type: str, status: str,
                           exit_reason: str = "") -> None:
        node = self._job_ctx.get_node(node_type, node_id)
        if node is None:
            node = Node(node_type=node_type, node_id=node_id, rank_index=node_id,
                        max_relaunch_count=self._ctx.max_relaunch_count)
        changed = node.update_status(status)
        if exit_reason:
            node.exit_reason = exit_reason
        self._job_ctx.update_node(node)
        if changed and status == NodeStatus.FAILED:
            self._handle_node_failure(node)

    def record_heartbeat(self, node_id: int, timestamp: float) -> None:
        node = self._job_ctx.get_node(NodeType.WORKER, node_id)
        if node is not None:
            node.heartbeat_time = timestamp
            self._job_ctx.update_node(node)

    def handle_failure_report(self, node_id: int, error_data: str, restart_count: int) -> None:
        node = self._job_ctx.get_node(NodeType.WORKER, node_id)
        if node is None:
            return
        node.relaunch_count = max(node.relaunch_count, restart_count)
        self._job_ctx.update_node(node)
        logger.warning("node %s reported failure: %s", node_id, error_data[:500])

    # -- relaunch policy ---------------------------------------------------

    def _handle_node_failure(self, node: Node, deleted: bool = False) -> None:
        """Relaunch the node while its budget lasts, else abort the job when
        no worker can be relaunched any more."""
        if self._relaunchable(node):
            node.inc_relaunch_count()
            self._job_ctx.update_node(node)
            logger.info("relaunching node %s (count %s/%s, reason=%s)", node.node_id,
                        node.relaunch_count, node.max_relaunch_count, node.exit_reason)
            self._job_ctx.node_actions.add_action(NodeAction(
                node_id=node.node_id, action_type=DiagnosisActionType.RELAUNCH_WORKER,
                reason=node.exit_reason or ("deleted" if deleted else "failed")))
        elif not self._fault_tolerance_left():
            self._job_ctx.master_actions.add_action(
                JobAbortionAction(reason=JobExitReason.MAX_RELAUNCH))

    def _relaunchable(self, node: Node) -> bool:
        if self._ctx.relaunch_always:
            return True
        return node.should_relaunch()

    def _fault_tolerance_left(self) -> bool:
        workers = self._job_ctx.get_nodes(NodeType.WORKER)
        return any(n.should_relaunch() for n in workers.values() if not n.exited())

    # -- heartbeat monitor -------------------------------------------------

    def _monitor_heartbeats(self) -> None:
        interval = max(1.0, self._ctx.heartbeat_interval_s)
        while not self._stopped.wait(interval) and not self._job_ctx.is_stopped():
            try:
                self._check_dead_nodes()
            except Exception:  # noqa: BLE001 — the monitor outlives one bad pass
                logger.exception("heartbeat monitor error")

    def _check_dead_nodes(self) -> None:
        """No heartbeat within ``heartbeat_deadline_s`` → the node is dead."""
        deadline = self._ctx.heartbeat_deadline_s
        now = time.time()
        for node in self._job_ctx.get_nodes(NodeType.WORKER).values():
            if node.exited() or node.heartbeat_time <= 0:
                continue
            if now - node.heartbeat_time > deadline:
                logger.warning("node %s heartbeat lost for %.0fs; marking failed",
                               node.node_id, now - node.heartbeat_time)
                node.exit_reason = NodeExitReason.KILLED
                self.update_node_status(node.node_id, node.node_type, NodeStatus.FAILED,
                                        NodeExitReason.KILLED)

    # -- queries -----------------------------------------------------------

    @staticmethod
    def _scaled_out(n) -> bool:
        # removed on purpose by a scale-down: not counted for completion
        return n.is_released and not n.relaunchable

    def all_workers_exited(self) -> bool:
        workers = [n for n in self._job_ctx.get_nodes(NodeType.WORKER).values()
                   if not self._scaled_out(n)]
        return bool(workers) and all(n.exited() for n in workers)

    def all_workers_succeeded(self) -> bool:
        workers = [n for n in self._job_ctx.get_nodes(NodeType.WORKER).values()
                   if not self._scaled_out(n)]
        return bool(workers) and all(n.status == NodeStatus.SUCCEEDED for n in workers)

    def alive_workers(self) -> List[Node]:
        return [n for n in self._job_ctx.get_nodes(NodeType.WORKER).values()
                if n.status == NodeStatus.RUNNING]
